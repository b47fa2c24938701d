"""Synthetic textured room and trajectories (port of
geoflowslam_tpu/io/synthetic.py, the pinhole RGB-D part and the hard-mode
sequence).

The texture is the reference's numpy value noise (RandomState(seed)), so
both packages render the same room; rays, plane hits and the bilinear
texture lookup are float32 tensor code on the world's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from geoflowslam_tpu_torch.math import lie

GRAVITY = np.array([0.0, 0.0, -9.81], np.float32)


def make_texture(seed: int, size: int = 1024, octaves: int = 5) -> np.ndarray:
    """Multi-octave value-noise texture in [20, 235], strong local gradients."""
    tex = np.zeros((size, size), np.float32)
    rng = np.random.RandomState(int(seed))
    for o in range(octaves):
        cells = 8 << o
        grid = rng.rand(cells + 1, cells + 1).astype(np.float32)
        ys = np.linspace(0, cells, size, endpoint=False)
        xs = np.linspace(0, cells, size, endpoint=False)
        y0 = ys.astype(int)
        x0 = xs.astype(int)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        g = grid
        v = (g[y0][:, x0] * (1 - fy) * (1 - fx)
             + g[y0][:, x0 + 1] * (1 - fy) * fx
             + g[y0 + 1][:, x0] * fy * (1 - fx)
             + g[y0 + 1][:, x0 + 1] * fy * fx)
        tex += v / (1.5 ** o)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    return (tex * 215.0 + 20.0).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class Camera:
    fx: float = 400.0
    fy: float = 400.0
    cx: float = 320.0
    cy: float = 240.0
    width: int = 640
    height: int = 480


_AXES_U = ((0, 1, 0), (0, 1, 0), (1, 0, 0), (1, 0, 0), (1, 0, 0), (1, 0, 0))
_AXES_V = ((0, 0, 1), (0, 0, 1), (0, 0, 1), (0, 0, 1), (0, 1, 0), (0, 1, 0))


class SyntheticWorld:
    """A textured box room (4 walls, floor, ceiling) centred at the origin.
    World frame: x right, y down, z forward."""

    def __init__(self, cam: Camera = Camera(), seed: int = 7,
                 half_extent=(3.0, 2.0, 4.0), tex_scale: float = 0.7, *,
                 device: torch.device | str):
        self.cam = cam
        self.device = torch.device(device)
        self.tex = torch.from_numpy(make_texture(seed)).to(self.device)
        self.tex_scale = tex_scale
        f32 = dict(dtype=torch.float32, device=self.device)
        self.normals = torch.tensor(
            [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
             [0, 0, -1]], **f32)
        hx, hy, hz = half_extent
        self.offsets = torch.tensor([hx, hx, hy, hy, hz, hz], **f32)
        self.axes_u = torch.tensor(_AXES_U, **f32)
        self.axes_v = torch.tensor(_AXES_V, **f32)
        ys = torch.arange(cam.height, **f32)[:, None]
        xs = torch.arange(cam.width, **f32)[None, :]
        shape = (cam.height, cam.width)
        self.dirs_c = torch.stack([
            torch.broadcast_to((xs - cam.cx) / cam.fx, shape),
            torch.broadcast_to((ys - cam.cy) / cam.fy, shape),
            torch.ones(shape, **f32),
        ], dim=-1)

    @torch.no_grad()
    def render(self, rot_cw: torch.Tensor, t_cw: torch.Tensor):
        """Render from Tcw. Returns (gray [H, W], depth [H, W]) float32."""
        rot_cw = rot_cw.to(self.device, torch.float32)
        t_cw = t_cw.to(self.device, torch.float32)
        rot_wc = rot_cw.T
        origin = -rot_wc @ t_cw
        dirs_w = torch.einsum("ij,hwj->hwi", rot_wc, self.dirs_c)

        # inward planes n.x = -offset: t = -(n.o + d) / n.dir
        n_dot_d = torch.einsum("pi,hwi->hwp", self.normals, dirs_w)
        n_dot_o = self.normals @ origin
        tt = -(n_dot_o + self.offsets)[None, None, :] / torch.where(
            torch.abs(n_dot_d) < 1e-6, 1e-6, n_dot_d)
        tt = torch.where(tt > 1e-3, tt, float("inf"))
        t_hit = torch.amin(tt, dim=-1)
        p_idx = torch.argmin(tt, dim=-1)
        pts_w = origin[None, None, :] + dirs_w * t_hit[..., None]

        au = self.axes_u[p_idx]
        av = self.axes_v[p_idx]
        pf = p_idx.float()
        u = torch.sum(pts_w * au, dim=-1) / self.tex_scale + 7.3 * pf
        v = torch.sum(pts_w * av, dim=-1) / self.tex_scale + 3.1 * pf
        g = sample_texture(self.tex, u, v)
        pc = torch.einsum("ij,hwj->hwi", rot_cw, pts_w) + t_cw
        return g, pc[..., 2]


def sample_texture(tex: torch.Tensor, u: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup of the tiled texture at (u, v) * 97, wrapped.

    A float32 remainder can return the modulus itself (a tiny negative
    argument rounds up), putting the +1 neighbour one past the edge; the
    indices clamp to the texture, as the reference's gathers do."""
    size = tex.shape[0]
    ui = torch.remainder(u * 97.0, size - 1.0)
    vi = torch.remainder(v * 97.0, size - 1.0)
    u0 = torch.floor(ui).long()
    v0 = torch.floor(vi).long()
    du = ui - u0
    dv = vi - v0
    u1 = torch.clamp(u0 + 1, max=size - 1)
    v1 = torch.clamp(v0 + 1, max=size - 1)
    return (tex[v0, u0] * (1 - du) * (1 - dv) + tex[v0, u1] * du * (1 - dv)
            + tex[v1, u0] * (1 - du) * dv + tex[v1, u1] * du * dv)


def smooth_trajectory(t: torch.Tensor, scale: float = 1.0):
    """Analytic Twc trajectory inside the room at times t [...]: returns
    (R_wc, p_w, v_w, a_w, w_body); the camera looks roughly +z."""
    p = torch.stack([
        0.8 * scale * torch.sin(0.5 * t),
        0.3 * scale * torch.sin(0.7 * t + 1.0),
        0.6 * scale * torch.sin(0.4 * t),
    ], dim=-1)
    v = torch.stack([
        0.4 * scale * torch.cos(0.5 * t),
        0.21 * scale * torch.cos(0.7 * t + 1.0),
        0.24 * scale * torch.cos(0.4 * t),
    ], dim=-1)
    a = torch.stack([
        -0.2 * scale * torch.sin(0.5 * t),
        -0.147 * scale * torch.sin(0.7 * t + 1.0),
        -0.096 * scale * torch.sin(0.4 * t),
    ], dim=-1)
    phi = torch.stack([
        0.10 * torch.sin(0.3 * t),
        0.15 * torch.sin(0.23 * t + 0.5),
        0.05 * torch.sin(0.17 * t),
    ], dim=-1)
    rot = lie.so3_exp(phi)
    phi_dot = torch.stack([
        0.03 * torch.cos(0.3 * t),
        0.0345 * torch.cos(0.23 * t + 0.5),
        0.0085 * torch.cos(0.17 * t),
    ], dim=-1)
    w_body = torch.einsum("...ij,...j->...i", lie.so3_right_jacobian(phi),
                          phi_dot)
    return rot, p, v, a, w_body


class SyntheticSequence:
    """Frames of a camera flying `smooth_trajectory` through the world."""

    def __init__(self, world: SyntheticWorld, fps: float = 30.0,
                 scale: float = 1.0):
        self.world = world
        self.fps = fps
        self.scale = scale

    def pose_cw(self, t: float):
        """Ground-truth Tcw at time t, float32 on the world's device."""
        tt = torch.tensor(float(t), dtype=torch.float32,
                          device=self.world.device)
        rot_wc, p, *_ = smooth_trajectory(tt, self.scale)
        rot_cw = rot_wc.T
        return rot_cw, -rot_cw @ p

    def frame(self, t: float):
        rot_cw, t_cw = self.pose_cw(t)
        gray, depth = self.world.render(rot_cw, t_cw)
        return gray, depth, (rot_cw, t_cw)


def hard_trajectory(t: torch.Tensor, period: float = 40.0):
    """Hard-mode Twc trajectory at times t [...]: a loop around the room that
    revisits its start every `period` seconds, a vertical bob, and a yaw
    sweep with fast-rotation bursts (the 1.9 rad/s term). Returns (R_wc,
    p_w, v_w, a_w, w_body) with exact derivatives, as smooth_trajectory."""
    om = 2.0 * np.pi / period
    p = torch.stack([
        1.6 * torch.sin(om * t),
        0.4 * torch.sin(3.0 * om * t + 1.0),
        1.6 * torch.cos(om * t) + 0.8,
    ], dim=-1)
    v = torch.stack([
        1.6 * om * torch.cos(om * t),
        1.2 * om * torch.cos(3.0 * om * t + 1.0),
        -1.6 * om * torch.sin(om * t),
    ], dim=-1)
    a = torch.stack([
        -1.6 * om * om * torch.sin(om * t),
        -3.6 * om * om * torch.sin(3.0 * om * t + 1.0),
        -1.6 * om * om * torch.cos(om * t),
    ], dim=-1)
    phi = torch.stack([
        0.12 * torch.sin(0.31 * t),
        0.35 * torch.sin(om * 2.0 * t) + 0.25 * torch.sin(1.9 * t),
        0.06 * torch.sin(0.21 * t),
    ], dim=-1)
    phi_dot = torch.stack([
        0.12 * 0.31 * torch.cos(0.31 * t),
        0.35 * 2.0 * om * torch.cos(om * 2.0 * t)
        + 0.25 * 1.9 * torch.cos(1.9 * t),
        0.06 * 0.21 * torch.cos(0.21 * t),
    ], dim=-1)
    rot = lie.so3_exp(phi)
    w_body = torch.einsum("...ij,...j->...i", lie.so3_right_jacobian(phi),
                          phi_dot)
    return rot, p, v, a, w_body


def contrast_schedule(t: float, period: float = 40.0) -> float:
    """Texture contrast multiplier in [0.12, 1] at time t (host float): two
    texture-poor windows per loop."""
    s = 0.5 * (1.0 + np.cos(2.0 * np.pi * 2.0 * t / period))
    return 0.12 + 0.88 * float(s) ** 6


class HardSyntheticSequence:
    """The hard-mode sequence: loop revisits every `period` s, fast-rotation
    bursts and texture-poor segments (contrast pulled towards 110; depth is
    untouched, as on a real blank wall)."""

    def __init__(self, world: SyntheticWorld, fps: float = 30.0,
                 imu_rate: float = 200.0, period: float = 40.0):
        self.world = world
        self.fps = fps
        self.imu_rate = imu_rate
        self.period = period

    def pose_cw(self, t: float):
        """Ground-truth Tcw at time t, float32 on the world's device."""
        tt = torch.tensor(float(t), dtype=torch.float32,
                          device=self.world.device)
        rot_wc, p, *_ = hard_trajectory(tt, self.period)
        rot_cw = rot_wc.T
        return rot_cw, -rot_cw @ p

    def frame(self, t: float):
        rot_cw, t_cw = self.pose_cw(t)
        gray, depth = self.world.render(rot_cw, t_cw)
        c = contrast_schedule(t, self.period)
        if c < 0.999:
            gray = 110.0 + (gray - 110.0) * c
        return gray, depth, (rot_cw, t_cw)

    def imu_between(self, t0: float, t1: float, max_samples: int):
        """Padded IMU samples in (t0, t1]: (acc [S, 3], gyro [S, 3], dt [S])
        in the body frame, float32 on the world's device."""
        dev = self.world.device
        dt = 1.0 / self.imu_rate
        n = max(int(round((t1 - t0) * self.imu_rate)), 0)
        idx = torch.arange(max_samples, device=dev)
        ts = t0 + (idx.float() + 0.5) * dt
        rot_wb, _, _, a_w, w_body = hard_trajectory(ts, self.period)
        acc_b = torch.einsum("sij,sj->si", rot_wb.transpose(-1, -2),
                             a_w - torch.from_numpy(GRAVITY).to(dev))
        dts = torch.where(idx < n, dt, 0.0)
        return (acc_b.float(), w_body.float(), dts.float())
