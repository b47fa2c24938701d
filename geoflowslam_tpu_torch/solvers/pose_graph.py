"""Pose-graph optimisation over Sim3/SE3 (port of
geoflowslam_tpu/solvers/pose_graph.py): the essential graph with optional
4DoF (yaw-only) updates, and the two-KF Sim3 refinement.

Dense Gauss-Newton over the stacked tangent of every KF slot (7 K
parameters), as in the reference. Edge list: (i, j, s_ij, R_ij, t_ij,
weight, valid) with measurement S_ij = S_i S_j^-1 (g2o convention) and
residual e = log(S_ij S_j S_i^-1) in the sim3 tangent [rho, phi, sigma].

The reference differentiates with jax.jacfwd over all 7 K parameters. An
edge's residual depends only on its two endpoints, so here forward-mode
AD (torch.func.jvp) pushes the 14 tangent directions of (xi_i, xi_j)
through all edges at once, batched, and the [E, 7, 7 K] Jacobian is
scattered from those blocks: the same derivatives, without 7 K passes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp

from geoflowslam_tpu_torch.math import lie


class PoseGraphEdges(NamedTuple):
    i: torch.Tensor       # [E] int
    j: torch.Tensor       # [E] int
    s: torch.Tensor       # [E] measured relative scale
    rot: torch.Tensor     # [E, 3, 3] measured relative rotation
    t: torch.Tensor       # [E, 3]
    weight: torch.Tensor  # [E] information weight
    valid: torch.Tensor   # [E] bool


def _sim3_log(s, rot, t):
    """Inverse of lie.sim3_exp, batched: log of the rotation and the scale,
    then W rho = t with W the matrix sim3_exp builds at (phi, sigma). t is
    linear in rho, so W's columns are sim3_exp's translations at the unit
    rho vectors (what jax.jacfwd of t(rho) computes)."""
    sigma = torch.log(s)
    phi = lie.so3_log(rot)
    eye = torch.eye(3, dtype=t.dtype, device=t.device)
    probe = torch.cat([eye.expand(phi.shape[:-1] + (3, 3)),
                       phi[..., None, :].expand(phi.shape[:-1] + (3, 3)),
                       sigma[..., None, None].expand(phi.shape[:-1] + (3, 1))],
                      dim=-1)                                  # [..., 3, 7]
    w_mat = lie.sim3_exp(probe)[2].transpose(-1, -2)           # [..., 3, 3]
    rho = torch.linalg.solve_ex(w_mat + 1e-9 * eye, t[..., None])[0][..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def _pose(xi, base_s, base_rot, base_t, fix_scale: bool):
    if fix_scale:
        xi = torch.cat([xi[..., :6], torch.zeros_like(xi[..., 6:])], dim=-1)
    ds, dr, dt = lie.sim3_exp(xi)
    return lie.sim3_compose(ds, dr, dt, base_s, base_rot, base_t)


def edge_residuals(xi_i, xi_j, edges: PoseGraphEdges, base_s, base_rot,
                   base_t, fix_scale: bool):
    """[E, 7] residuals of the edges given the tangent updates of their
    endpoints, applied left-multiplicatively: S_k = exp(xi_k) S_k0."""
    i, j = edges.i.long(), edges.j.long()
    si, ri, ti = _pose(xi_i, base_s[i], base_rot[i], base_t[i], fix_scale)
    sj, rj, tj = _pose(xi_j, base_s[j], base_rot[j], base_t[j], fix_scale)
    s1, r1, t1 = lie.sim3_compose(edges.s, edges.rot, edges.t, si, ri, ti)
    sii, rii, tii = lie.sim3_inverse(s1, r1, t1)
    se, re, te = lie.sim3_compose(sj, rj, tj, sii, rii, tii)
    return _sim3_log(se, re, te)


def _residuals_and_jacobian(xi_all, edges, base_s, base_rot, base_t,
                            fix_scale: bool):
    """Residuals [E, 7] and the dense Jacobian [E, 7, 7 K]."""
    k = xi_all.shape[0]
    e = edges.i.shape[0]
    i, j = edges.i.long(), edges.j.long()
    xij = torch.cat([xi_all[i], xi_all[j]], dim=1)              # [E, 14]

    def f(x):
        return edge_residuals(x[..., :7], x[..., 7:], _bcast(edges, x),
                              base_s, base_rot, base_t, fix_scale)

    eye = torch.eye(14, dtype=xij.dtype, device=xij.device)
    x14 = xij[None].expand(14, e, 14).contiguous()
    tangents = eye[:, None, :].expand(14, e, 14).contiguous()
    r14, jt = jvp(f, (x14,), (tangents,))                       # [14, E, 7]
    r = r14[0]
    blocks = jt.permute(1, 2, 0)                                # [E, 7, 14]
    jac = torch.zeros((e, 7, k, 7), dtype=r.dtype, device=r.device)
    rows = torch.arange(e, device=r.device)
    jac[rows, :, i, :] += blocks[:, :, :7]
    jac[rows, :, j, :] += blocks[:, :, 7:]
    return r, jac.reshape(e, 7, 7 * k)


def _bcast(edges: PoseGraphEdges, x):
    """The edge measurements broadcast over the tangent batch of x."""
    lead = x.shape[:-2]
    return edges._replace(
        s=edges.s.expand(lead + edges.s.shape),
        rot=edges.rot.expand(lead + edges.rot.shape),
        t=edges.t.expand(lead + edges.t.shape))


def warm_forward_ad(device) -> None:
    """Run one tiny jvp through the Sim3 residual. The first forward-mode
    AD call of a process that mixes dual and plain tensors imports torch's
    compiler stack (torch._dynamo: seconds, ~12 s on a fresh machine);
    the loop closer pays it when it is built, not in the frame that closes
    the first loop."""
    xi = torch.zeros((1, 7), device=device)
    one = torch.ones((1,), device=device)
    eye = torch.eye(3, device=device)[None]
    jvp(lambda x: lie.sim3_apply(*_pose(x, one, eye, xi[:, :3], False),
                                 xi[:, None, :3]),
        (xi,), (torch.ones_like(xi),))


def optimize_pose_graph(base_s, base_rot, base_t, kf_valid, kf_fixed,
                        edges: PoseGraphEdges, fix_scale: bool = True,
                        iters: int = 15, yaw_only: bool = False):
    """Dense GN over the whole graph. Returns updated (s, rot, t) per KF.

    kf_fixed: poses held constant (the loop KF in CorrectLoop). fix_scale:
    Sim3 reduces to SE3 (stereo/RGB-D). yaw_only: rotation updates about
    the world z axis only (OptimizeEssentialGraph4DoF)."""
    k = base_s.shape[0]
    dev, dt = base_s.device, base_s.dtype
    w = edges.weight * edges.valid.to(dt)
    comp = torch.arange(7, device=dev)
    free_mask = (kf_valid & ~kf_fixed).to(dt).repeat_interleave(7)
    if fix_scale:
        free_mask = free_mask * (comp != 6).to(dt).repeat(k)
    if yaw_only:
        free_mask = free_mask * ((comp != 3) & (comp != 4)).to(dt).repeat(k)
    eye = torch.eye(7 * k, dtype=dt, device=dev)
    xi = torch.zeros(7 * k, dtype=dt, device=dev)
    for _ in range(iters):
        r, jac = _residuals_and_jacobian(xi.reshape(k, 7), edges, base_s,
                                         base_rot, base_t, fix_scale)
        jw = jac * w[:, None, None]
        h = torch.einsum("eri,erj->ij", jw, jac)
        g = -torch.einsum("eri,er->i", jw, r)
        h = h * free_mask[:, None] * free_mask[None, :]
        h = h + torch.diag(1.0 - free_mask) + 1e-6 * eye
        dx = torch.linalg.solve_ex(h, g * free_mask)[0]
        xi = xi + torch.where(torch.all(torch.isfinite(dx)), dx, 0.0)
    xi_all = xi.reshape(k, 7)
    if fix_scale:
        xi_all = torch.cat([xi_all[:, :6], torch.zeros_like(xi_all[:, 6:])],
                           dim=1)
    ds, dr, dtr = lie.sim3_exp(xi_all)
    s_out, r_out, t_out = lie.sim3_compose(ds, dr, dtr, base_s, base_rot,
                                           base_t)
    return s_out, lie.normalize_rotation(r_out), t_out


def optimize_sim3_pair(s0, rot0, t0, pts1, pts2, valid, iters: int = 10,
                       fix_scale: bool = False, huber: float = 0.1):
    """Refine a Sim3 aligning pts1 -> pts2 (OptimizeSim3 on 3D-3D terms)
    with Huber-weighted GN. Returns (s, rot, t, inliers)."""
    dev, dt = pts1.device, pts1.dtype

    def params_res(xi):
        # xi [..., 7] -> predicted minus observed [..., P, 3]
        s, r, t = _pose(xi, s0, rot0, t0, fix_scale)
        return lie.sim3_apply(s, r, t, pts1) - pts2

    w_pt = valid.to(dt)
    eye7 = torch.eye(7, dtype=dt, device=dev)
    xi = torch.zeros(7, dtype=dt, device=dev)
    for _ in range(iters):
        r7, jt = jvp(params_res, (xi.expand(7, 7).contiguous(),),
                     (eye7,))                           # [7, P, 3]
        r = r7[0]
        jac = jt.permute(1, 2, 0)                               # [P, 3, 7]
        nrm = torch.linalg.norm(r, dim=1)
        wh = torch.where(nrm <= huber, 1.0,
                         huber / torch.clamp_min(nrm, 1e-9)) * w_pt
        h = torch.einsum("p,pri,prj->ij", wh, jac, jac) + 1e-6 * eye7
        g = -torch.einsum("p,pri,pr->i", wh, jac, r)
        dx = torch.linalg.solve_ex(h, g)[0]
        xi = xi + torch.where(torch.all(torch.isfinite(dx)), dx, 0.0)
    s, r, t = _pose(xi, s0, rot0, t0, fix_scale)
    err = torch.linalg.norm(lie.sim3_apply(s, r, t, pts1) - pts2, dim=1)
    return s, lie.normalize_rotation(r), t, valid & (err < huber)
