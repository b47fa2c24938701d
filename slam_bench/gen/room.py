"""The benchmark's synthetic room: texture, pinhole render, trajectory, IMU.

A frozen copy of geoflowslam_tpu_torch/io/synthetic.py (make_texture,
SyntheticWorld.render, sample_texture, smooth_trajectory, _imu_between) and
of the two SO(3) maps it uses from geoflowslam_tpu_torch/math/lie.py
(so3_exp, so3_right_jacobian). It imports nothing of the program, so a
change to the program's generator leaves the benchmark's traffic as it is.

What differs from the original: the trajectory is the same sum of sines with
its amplitudes, frequencies and phases read from a traffic file (the
original's numbers are the `walk` mix), evaluated at t0 + t with a seeded
offset t0, in the dtype of the time tensor (float64 for the ground truth,
float32 for the render, bfloat16 for the comparison's control); the IMU
samples of many frames come from one call.
"""
from __future__ import annotations

import numpy as np
import torch

GRAVITY = (0.0, 0.0, -9.81)
_EPS = 1e-8
_AXES_U = ((0, 1, 0), (0, 1, 0), (1, 0, 0), (1, 0, 0), (1, 0, 0), (1, 0, 0))
_AXES_V = ((0, 0, 1), (0, 0, 1), (0, 0, 1), (0, 0, 1), (0, 1, 0), (0, 1, 0))


def make_texture(seed: int, size: int = 1024, octaves: int = 5) -> np.ndarray:
    """Multi-octave value-noise texture in [20, 235]."""
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


def hat(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], dim=-1),
                        torch.stack([z, zero, -x], dim=-1),
                        torch.stack([-y, x, zero], dim=-1)], dim=-2)


def _coef(phi: torch.Tensor):
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp_min(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    return a, b, c


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    a, b, _ = _coef(phi)
    k = hat(phi)
    eye = torch.eye(3, dtype=k.dtype, device=k.device).expand(k.shape)
    return eye + a[..., None, None] * k + b[..., None, None] * (k @ k)


def so3_right_jacobian(phi: torch.Tensor) -> torch.Tensor:
    _, b, c = _coef(phi)
    k = hat(phi)
    eye = torch.eye(3, dtype=k.dtype, device=k.device).expand(k.shape)
    return eye - b[..., None, None] * k + c[..., None, None] * (k @ k)


class Trajectory:
    """Camera (= IMU body) path inside the room: per axis
    p = amp sin(freq t + phase) and rotation vector phi = amp sin(freq t +
    phase), at times t0 + t. `spec` is the traffic file's "trajectory"."""

    def __init__(self, spec: dict, t0: float):
        self.pos = [spec["position"][k] for k in ("amp", "freq", "phase")]
        self.rot = [spec["rotation"][k] for k in ("amp", "freq", "phase")]
        self.t0 = float(t0)

    def __call__(self, t: torch.Tensor):
        """(R_wc, p_w, v_w, a_w, w_body) at times t [...] in t's dtype."""
        tt = t + self.t0

        def terms(spec):
            amp, freq, phase = (torch.tensor(x, dtype=t.dtype,
                                             device=t.device) for x in spec)
            arg = tt[..., None] * freq + phase
            return amp, freq, torch.sin(arg), torch.cos(arg)

        amp, freq, s, c = terms(self.pos)
        p, v, a = amp * s, amp * freq * c, -amp * freq * freq * s
        amp, freq, s, c = terms(self.rot)
        phi, phi_dot = amp * s, amp * freq * c
        w_body = torch.einsum("...ij,...j->...i", so3_right_jacobian(phi),
                              phi_dot)
        return so3_exp(phi), p, v, a, w_body

    def pose_cw(self, t: torch.Tensor):
        """(R_cw [..., 3, 3], t_cw [..., 3]) at times t."""
        rot_wc, p, *_ = self(t)
        rot_cw = rot_wc.transpose(-1, -2)
        return rot_cw, -torch.einsum("...ij,...j->...i", rot_cw, p)

    def twc_np(self, times) -> np.ndarray:
        """Ground-truth Twc [N, 4, 4] float64 at host times."""
        rot_wc, p, *_ = self(torch.as_tensor(np.asarray(times, np.float64)))
        out = np.tile(np.eye(4), (len(times), 1, 1))
        out[:, :3, :3] = rot_wc.numpy()
        out[:, :3, 3] = p.numpy()
        return out

    def imu(self, t_frames: np.ndarray, rate: float, max_samples: int,
            device) -> tuple:
        """IMU samples of every frame i >= 1 in (t[i-1], t[i]] at `rate`
        Hz, midpoints of the intervals, padded to max_samples rows with dt
        0: host float32 (acc [N-1, S, 3], gyro [N-1, S, 3], dt [N-1, S])."""
        dt = 1.0 / rate
        t_prev = torch.as_tensor(t_frames[:-1], dtype=torch.float64)
        n = torch.round((torch.as_tensor(t_frames[1:]) - t_prev) * rate)
        idx = torch.arange(max_samples, dtype=torch.float64)
        ts = (t_prev[:, None] + (idx[None, :] + 0.5) * dt).float().to(device)
        rot_wb, _, _, a_w, w_body = self(ts)
        g = torch.tensor(GRAVITY, device=device)
        acc = torch.einsum("fsij,fsj->fsi", rot_wb.transpose(-1, -2), a_w - g)
        dts = torch.where(idx[None, :] < n[:, None], dt, 0.0).float()
        return (acc.float().cpu().numpy(), w_body.float().cpu().numpy(),
                dts.numpy())


class Room:
    """A textured box room (4 walls, floor, ceiling) centred at the origin,
    seen by a pinhole camera (fx, fy, cx, cy, width, height)."""

    def __init__(self, cam: dict, tex_seed: int, device,
                 half_extent=(3.0, 2.0, 4.0), tex_scale: float = 0.7):
        self.device = torch.device(device)
        self.tex = torch.from_numpy(make_texture(tex_seed)).to(self.device)
        self.tex_scale = tex_scale
        f32 = dict(dtype=torch.float32, device=self.device)
        self.normals = torch.tensor(
            [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
             [0, 0, -1]], **f32)
        hx, hy, hz = half_extent
        self.offsets = torch.tensor([hx, hx, hy, hy, hz, hz], **f32)
        self.axes_u = torch.tensor(_AXES_U, **f32)
        self.axes_v = torch.tensor(_AXES_V, **f32)
        h, w = cam["height"], cam["width"]
        ys = torch.arange(h, **f32)[:, None]
        xs = torch.arange(w, **f32)[None, :]
        self.dirs_c = torch.stack([
            torch.broadcast_to((xs - cam["cx"]) / cam["fx"], (h, w)),
            torch.broadcast_to((ys - cam["cy"]) / cam["fy"], (h, w)),
            torch.ones((h, w), **f32)], dim=-1)

    @torch.no_grad()
    def render(self, rot_cw: torch.Tensor, t_cw: torch.Tensor):
        """(gray [H, W], depth [H, W] in metres) float32 from Tcw."""
        rot_wc = rot_cw.T
        origin = -rot_wc @ t_cw
        dirs_w = torch.einsum("ij,hwj->hwi", rot_wc, self.dirs_c)
        n_dot_d = torch.einsum("pi,hwi->hwp", self.normals, dirs_w)
        n_dot_o = self.normals @ origin
        tt = -(n_dot_o + self.offsets)[None, None, :] / torch.where(
            torch.abs(n_dot_d) < 1e-6, 1e-6, n_dot_d)
        tt = torch.where(tt > 1e-3, tt, float("inf"))
        t_hit = torch.amin(tt, dim=-1)
        p_idx = torch.argmin(tt, dim=-1)
        pts_w = origin[None, None, :] + dirs_w * t_hit[..., None]
        pf = p_idx.float()
        u = torch.sum(pts_w * self.axes_u[p_idx], dim=-1) / self.tex_scale \
            + 7.3 * pf
        v = torch.sum(pts_w * self.axes_v[p_idx], dim=-1) / self.tex_scale \
            + 3.1 * pf
        g = _sample_texture(self.tex, u, v)
        pc = torch.einsum("ij,hwj->hwi", rot_cw, pts_w) + t_cw
        return g, pc[..., 2]


def _sample_texture(tex, u, v):
    size = tex.shape[0]
    ui = torch.remainder(u * 97.0, size - 1.0)
    vi = torch.remainder(v * 97.0, size - 1.0)
    u0, v0 = torch.floor(ui), torch.floor(vi)
    du, dv = ui - u0, vi - v0
    u0 = torch.nan_to_num(u0).long().clamp(0, size - 1)
    v0 = torch.nan_to_num(v0).long().clamp(0, size - 1)
    u1 = torch.clamp(u0 + 1, max=size - 1)
    v1 = torch.clamp(v0 + 1, max=size - 1)
    return (tex[v0, u0] * (1 - du) * (1 - dv) + tex[v0, u1] * du * (1 - dv)
            + tex[v1, u0] * (1 - du) * dv + tex[v1, u1] * du * dv)
